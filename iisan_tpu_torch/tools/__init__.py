"""Dataset-preparation command lines of the port: ``build_lmdb`` writes
the item-image LMDB from a directory of JPEGs, and ``build_caches`` runs
the frozen towers over a dataset's catalogue into hidden-state stores."""
