"""Retrieval-augmented search: document loading and splitting, the segmented
on-disk index and the in-memory SearchIndex (port of kjarni_tpu/rag)."""
