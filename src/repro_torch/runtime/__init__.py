"""Runtime helpers of the port (mirrors ``repro.runtime``): so far the
kernel half of the roofline model (``roofline``)."""
