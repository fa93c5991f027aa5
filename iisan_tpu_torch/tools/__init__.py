"""Dataset-preparation command lines of the port: ``build_caches`` runs
the frozen towers over a dataset's catalogue into hidden-state stores."""
