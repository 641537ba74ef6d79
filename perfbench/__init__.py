"""The port's benchmark: filtered top-k search through ``repro_torch``.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Everything that measures (traffic, the
reference, the bounds, the metric readers) lives here, apart from the
program under test.
"""
