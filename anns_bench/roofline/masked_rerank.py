"""``csrc/masked_rerank.cu`` (pass 2 of the masked-full query): every point's
SC-score against the query's threshold, the exact distance of each admitted
candidate, a running top-k. A batch's work: one 32-bit operation a (point,
subspace, 32 queries) for the collision test, 2 d flops a candidate, the
collision inputs, the queries, the rows some checked query admitted (a lower
bound of those the batch admits) and the (id, distance) answers."""
from __future__ import annotations

from anns_bench.rooflines import collision_inputs

KERNELS = ("rerank_chunk_kernel", "merge_chunks_kernel", "copy_chunk_kernel")


def work(ctx, sh: dict) -> dict | None:
    cands = ctx.window.get("cand_total")
    rows = ctx.checked.get("touched")
    if cands is None or rows is None:
        return None
    per_batch = (collision_inputs(sh) + sh["q"] + 4 * sh["q"] * sh["d"]
                 + 4 * rows * sh["d"] + 8 * sh["q"] * sh["k"])
    return {"ops": {"cuda_core_32bit": sh["units"] * sh["words"] * sh["n"] * sh["n_sub"],
                    "tf32_tensor": 2 * sh["d"] * cands},
            "bytes": sh["units"] * per_batch}
