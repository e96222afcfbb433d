"""Command-line front doors: `batch` (pocketsphinx_batch) and `continuous`
(pocketsphinx_continuous, file mode)."""
