"""The port's trainer (``trainer``) and command line (``cli``)."""
