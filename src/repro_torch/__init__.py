"""PyTorch/CUDA port of the SVFF reproduction (``repro``, written in JAX).

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It never imports JAX or ``repro``. The
first slice is the paged serve path: ``serve.engine.ServeEngine`` over
the dense attention stack, with four hand-written CUDA kernels
(``kernels/csrc``) for prefill attention, paged decode over bf16 and
int8 pages, and fused sampling.
"""
