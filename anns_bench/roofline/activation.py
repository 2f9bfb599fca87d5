"""``csrc/activation.cu`` (the sort activation): for every (subspace, query)
problem the threshold tau and the retrieved count. A batch's work: one 32-bit
operation a cell sum (N_s x Q x K), the centroid distances of both halves in
f32, the subspaces' cell sizes in the narrowest integer that holds n, and
the two f32 outputs a problem."""
from __future__ import annotations

from anns_bench.peaks import int_bytes

KERNELS = ("sort_activation_kernel", "sort_activation_stream_kernel")


def work(ctx, sh: dict) -> dict:
    problems = sh["n_sub"] * sh["q"]
    per_batch = (2 * problems * sh["sqrt_k"] * 4 + sh["n_sub"] * sh["k2"] * int_bytes(sh["n"])
                 + 2 * problems * 4)
    return {"ops": {"cuda_core_32bit": sh["units"] * problems * sh["k2"]},
            "bytes": sh["units"] * per_batch}
