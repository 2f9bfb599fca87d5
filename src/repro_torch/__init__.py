"""repro_torch — the TaCo subspace-collision index on PyTorch and CUDA.

A port of the JAX package ``repro`` for an NVIDIA Hopper card. Module names
mirror ``repro`` so each function has an obvious counterpart there; ``repro``
stays the reference the port is tested against.

It covers ``AnnIndex.build`` (paper Alg. 1-3, random or k-means++ seeding)
and ``search`` (Alg. 4-6) with both re-rank pipelines (``gather``, the
default, and ``masked_full``), all three activations and both selections,
so every configuration of ``repro_torch.core.config`` runs, and the mutable
index (``AnnIndex.mutable``: delta-segment inserts, tombstone deletes, a
write-ahead log and compaction), with its own ``obs`` metrics and tracing
and the shared background ``WorkerPool``, served single-device or
corpus-sharded (``repro_torch.core.distributed``). Six hand-written CUDA kernels
(``csrc/``) carry it on the card; each has a plain PyTorch version beside
it that the CPU path and the tests use.

Float32 on this path means IEEE float32: TF32 is switched off for matrix
products and convolutions when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
