"""The benchmark of ``panoptikon_tpu_torch`` on one NVIDIA GPU.

One run measures one cell of ``BENCHMARK.json`` (``python3 benchmark/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``). Everything that
belongs to one configuration, traffic mix or metric is a file found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``limits/<cell>.json``,
``metrics/<metric>.py``, and the code a traffic mix's ``kind`` names,
``kinds/<kind>.py``. Nothing here imports JAX or the JAX package; the plain
references under ``references/`` import nothing of the program either.
"""
