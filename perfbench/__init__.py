"""The benchmark of trace_tpu_torch on one NVIDIA H100 (see run.py)."""
