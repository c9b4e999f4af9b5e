"""Host-side analysis: per-image post-processing, evaluation, source finding."""
