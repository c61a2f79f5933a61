"""Host-side data helpers: image normalization and bundled class metadata."""
