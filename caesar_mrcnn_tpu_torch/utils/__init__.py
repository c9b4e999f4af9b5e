"""Box math, image geometry and result comparison for the port."""
