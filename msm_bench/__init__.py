"""The benchmark of ``msm_tpu_torch``: fixed-base MSM throughput and tail
through the program's serving plan (``README.md``)."""
