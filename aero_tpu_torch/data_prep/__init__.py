"""Command lines of the offline dataset preparation (the twins of the
repository's ``data_prep/`` scripts)."""
