"""Device choice and metrics."""
