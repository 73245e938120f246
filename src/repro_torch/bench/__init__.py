"""The paper's Table I and II benchmarks on the port (mirror
``benchmarks/table1.py`` and ``benchmarks/table2.py``)."""
