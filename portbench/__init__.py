"""The benchmark of ``seal_tpu_torch``, the PyTorch and CUDA port: the
harness, the traffic generator, the inputs, the roofline arithmetic and the
plain reference.  ``run.py`` is the entry point."""
