"""Scene files, image writers, checkpoints and the native display bridge."""
