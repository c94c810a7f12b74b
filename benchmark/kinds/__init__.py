"""The kinds of traffic: one module each, reading the parameters of a mix (`traffic/<name>.json`)."""
