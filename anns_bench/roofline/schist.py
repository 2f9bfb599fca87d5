"""``csrc/schist.cu`` (pass 1 of the masked-full query): the per-query
histogram of SC-scores. A batch's work: one 32-bit operation a (point,
subspace, 32 queries), the collision inputs, the (Q, N_s + 1) counts."""
from __future__ import annotations

from anns_bench.rooflines import collision_inputs

KERNELS = ("schist_kernel", "schist_wide_kernel")


def work(ctx, sh: dict) -> dict:
    per_batch = collision_inputs(sh) + 4 * sh["q"] * (sh["n_sub"] + 1)
    return {"ops": {"cuda_core_32bit": sh["units"] * sh["words"] * sh["n"] * sh["n_sub"]},
            "bytes": sh["units"] * per_batch}
