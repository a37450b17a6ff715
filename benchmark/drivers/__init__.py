"""One module per traffic kind, named by a traffic file's `kind`; each
has `run(ctx) -> harness.Outcome`."""
