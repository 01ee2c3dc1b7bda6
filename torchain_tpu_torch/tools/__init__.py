"""tools — small programs run by hand (`python -m torchain_tpu_torch.tools.<name>`)."""
