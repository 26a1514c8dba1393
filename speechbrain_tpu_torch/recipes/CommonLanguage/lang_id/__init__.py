"""The CommonLanguage lang_id twin."""
