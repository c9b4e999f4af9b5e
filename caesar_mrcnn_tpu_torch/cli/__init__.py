"""Command-line applications of the port: ``run`` (train/test/detect) and the legacy
``train_all`` shim."""
