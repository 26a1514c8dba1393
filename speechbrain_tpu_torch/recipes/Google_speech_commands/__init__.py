"""Google Speech Commands recipes on the PyTorch port (the twins of
``recipes/Google-speech-commands``; a package name cannot hold a
hyphen)."""
