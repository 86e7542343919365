from deflatedmlmc_schwinger_tpu_torch.trace.hutchinson import hutchinson  # noqa: F401
