"""The user-facing examples of the port (mirror ``examples/`` of the JAX
package), each run as ``python -m repro_torch.examples.<name>`` and each
on the card unless ``--device cpu`` is given: ``quickstart`` (the QMP
control plane driving train tenants), ``elastic_reconf`` (reconfiguration
through pause, elastic rescaling, a supervised failure), ``serve_batched``
(a serving engine paused mid-traffic) and ``train_100m`` (a ~100M
qwen3-family model through ``launch.train``)."""
