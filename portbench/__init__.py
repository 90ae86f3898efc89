"""The benchmark of ``transform360_tpu_torch`` on an NVIDIA card: one
cell, one run, one result line (``python3 portbench/run.py``; see
``README.md``)."""
