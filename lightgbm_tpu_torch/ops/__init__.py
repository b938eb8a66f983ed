"""Device ops of the port: histograms, best split, leaf lookup, growth,
predict.  Each module with a hand-written kernel keeps the kernel's
plain PyTorch version beside its wrapper."""
