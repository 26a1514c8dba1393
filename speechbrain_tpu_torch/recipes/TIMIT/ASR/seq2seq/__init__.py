"""The TIMIT seq2seq twin."""
