"""PyTorch/CUDA port of ``reranking_multimodal_retrievers_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``engine/``, ``serving/``) and replaces its
Pallas TPU kernels with CUDA kernels written for Hopper (``csrc/``). It
imports ``torch`` and ``numpy`` and never JAX or the JAX package.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a CPU
tensor every kernel wrapper takes its plain PyTorch version.
"""
