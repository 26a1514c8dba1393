"""The Aishell1Mix separation twin."""
