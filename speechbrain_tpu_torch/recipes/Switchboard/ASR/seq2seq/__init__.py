"""The Switchboard seq2seq twin."""
