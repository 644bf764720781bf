"""Deployment exporters (browser bundle, …): the port of kjarni_tpu/export."""
