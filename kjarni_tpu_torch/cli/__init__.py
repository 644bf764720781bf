"""The port's `kjarni` command line (kjarni_tpu/cli)."""
