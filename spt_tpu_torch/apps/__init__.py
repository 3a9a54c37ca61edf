"""Command-line applications: ``render_cli`` (scene file -> image) and
``inverse_render`` (BASELINE config 4), each run as
``python -m spt_tpu_torch.apps.<name>``."""
