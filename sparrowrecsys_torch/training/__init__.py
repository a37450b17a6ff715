"""Checkpoint loading (flax msgpack exports into torch modules)."""
