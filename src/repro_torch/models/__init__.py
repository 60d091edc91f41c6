"""The LM substrate: configuration, layers, mixers, model assembly."""
