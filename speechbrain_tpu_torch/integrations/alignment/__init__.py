"""The reference's ``integrations/alignment`` layout: diarization."""
