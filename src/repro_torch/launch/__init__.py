"""Entry points of the port: step builders and the LM decode-serving loop."""
