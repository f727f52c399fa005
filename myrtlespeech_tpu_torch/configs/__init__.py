"""Task configs of the port, built from ``myrtlespeech_tpu_torch.config.schema``."""
