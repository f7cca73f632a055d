"""Cost counting and the roofline of the port's dry-run records."""
