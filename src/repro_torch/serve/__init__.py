"""Serving: the online prototype store (register support shots, classify
queries).  The threaded engine is a later slice of the port."""
