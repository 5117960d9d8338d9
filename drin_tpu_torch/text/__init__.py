"""Text front of the port: the pure-Python BERT WordPiece tokenizer."""
