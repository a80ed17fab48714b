"""Camera interop for the port. The dataset loaders come in a later slice."""
