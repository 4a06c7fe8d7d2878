"""Model definitions: QAT forward, graph export and build recipes."""
