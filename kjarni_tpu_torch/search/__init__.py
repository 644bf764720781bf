"""Search primitives: BM25, a vector store scored on the card, reciprocal-rank
fusion and the result types (port of kjarni_tpu/search)."""
