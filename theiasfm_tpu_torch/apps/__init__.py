"""Command-line entry points of the port (port of the repo's apps/):
run as `python -m theiasfm_tpu_torch.apps.<name>`."""
