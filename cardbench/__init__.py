"""The benchmark of ``repro_torch`` on one CUDA card (see ``run.py``)."""
