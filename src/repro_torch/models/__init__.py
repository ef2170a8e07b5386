"""Model math of the port: layers, attention, the dense stack, Model."""
