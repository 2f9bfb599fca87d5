"""``csrc/scscore.cu`` (the gather query's collision count): the (Q, n)
SC-score matrix. A batch's work: one 32-bit operation a (point, subspace, 32
queries), the collision inputs, the scores in the narrowest integer that
holds 0 to N_s."""
from __future__ import annotations

from anns_bench.peaks import int_bytes
from anns_bench.rooflines import collision_inputs

KERNELS = ("scscore_kernel",)


def work(ctx, sh: dict) -> dict:
    per_batch = collision_inputs(sh) + sh["q"] * sh["n"] * int_bytes(sh["n_sub"])
    return {"ops": {"cuda_core_32bit": sh["units"] * sh["words"] * sh["n"] * sh["n_sub"]},
            "bytes": sh["units"] * per_batch}
