"""PyTorch/CUDA port of the SVFF reproduction (``repro``, written in JAX).

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It never imports JAX or ``repro``. Ported
so far: the paged serve path (``serve.engine.ServeEngine``) over dense
attention stacks and the hybrid Mamba-attention stack, the uniform-
position generate path (``train.step.make_serve_steps``), the SVFF
core with ``serve.fleet.ServeFleet`` running engines as tenants, and the
training path (``train.step.make_train_step``, the train
``core.Tenant``, ``launch.train`` and the Table I/II benchmarks in
``bench``), the sim plane (``sim``), the elastic fleet, every model
family of the JAX package, and pipeline-parallel serving
(``serve.pipeline_engine.PipelineServeEngine`` over the stage
templates of ``serve.stages``, with the manager's gang ops). Every
TPU kernel of the JAX package has a hand-written CUDA counterpart in
``kernels/csrc``: prefill attention, dense and paged decode (bf16 and
int8 pages), fused sampling, the chunked SSD scan, and the four staging
kernels.
"""
