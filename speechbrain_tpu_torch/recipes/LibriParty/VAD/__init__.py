"""The LibriParty VAD twin."""
