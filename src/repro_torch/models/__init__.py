"""Model stack of the port: configs, layers, transformer, zoo, weight carrier."""
