"""Port of ``bpp_tpu/tools``: the host tools of the CLI."""
