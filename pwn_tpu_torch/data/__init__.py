"""Training data (synthetic corpora, crops, prefetch)."""
