"""The benchmark of ``dawn_tpu_torch`` on the card, driven by ``BENCHMARK.json``.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once (:mod:`benchmark.run`); ``python3 -m benchmark.calibrate``
takes the readings that a cell's limits are set from. A cell's
configuration, traffic, limits and metric readers are files found by name
(:mod:`benchmark.manifest`); ``drivers/<family>.py`` drives the program and
``reference/<family>.py`` is the plain reference it is judged against. The
tests, on the CPU: ``python -m pytest benchmark/tests``.
"""
