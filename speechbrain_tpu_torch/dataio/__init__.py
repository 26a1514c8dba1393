"""Data loading: manifests, audio, datasets, batches, samplers, loaders."""
