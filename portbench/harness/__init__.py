"""The benchmark's own machinery: run context and window, the trace
reading, the roofline arithmetic and the comparison with the reference.
Nothing here is the program under test."""
