"""The benchmark of ``recmv_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON result line. Everything that belongs to one
configuration, traffic mix or per-layer metric is a file found by its
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``. ``reference/`` holds the frozen plain copy of the
step that decides ``correct`` (``check.py``).
"""
