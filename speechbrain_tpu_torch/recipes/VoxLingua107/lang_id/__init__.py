"""The VoxLingua107 lang_id twin."""
