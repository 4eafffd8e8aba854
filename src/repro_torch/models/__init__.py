"""Models of the port.  This slice ports the dense decoder family."""
