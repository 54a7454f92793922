"""The benchmark of the PyTorch/CUDA port (``pfb_imaging_tpu_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once: see ``harness.py``.
"""
