"""Tokenizer and FASTA reading."""
