"""The CommonVoice seq2seq twin."""
