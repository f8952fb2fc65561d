"""The benchmark of ``recmv_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON result line. Everything that belongs to one
configuration, traffic mix or per-layer metric is a file found by its
name: ``configs/<config>.json`` (and ``scenes/<module>.py`` where it
brings its own scene), ``traffic/<traffic>.json``, ``metrics/<metric>.py``,
``limits/<cell>.json``. ``reference/`` holds the frozen plain copy of the
step that decides ``correct`` (``check.py``).
"""
