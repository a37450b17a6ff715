"""Data loaders the serving catalog needs."""
