"""The benchmark's inputs: plain specs made from the seed (read by the
reference) and the program's objects built from the same specs."""
