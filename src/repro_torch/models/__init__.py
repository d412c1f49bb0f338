"""Model code: layers, attention and the dense decoder."""
