"""Runtime helpers of the port (mirrors ``repro.runtime``): the kernel
half of the roofline model (``roofline``) and the host-side GPipe
schedule of the serving pipeline (``pipeline``)."""
