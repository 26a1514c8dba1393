"""Switchboard data preparation (the CTC recipe's folder, where the
seq2seq script reads it from)."""
