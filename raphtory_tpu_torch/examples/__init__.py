"""Examples built on the port's engines."""
