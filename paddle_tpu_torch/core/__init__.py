"""Program IR, registry, LoD batches, device resolution and the executor."""
