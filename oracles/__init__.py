"""NumPy reference oracles, ported line-by-line from the cited reference
functions. These are the test ground truth for the device engines."""
