"""Data parallelism: processes and their communicator (``dist``), devices
and their rows of a global batch (``mesh``)."""
