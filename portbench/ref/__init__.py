"""Frozen copies the benchmark measures against: the BLS oracle and the
roofline arithmetic.  Nothing here imports the program under test."""
