"""The VoiceBank MetricGAN-U twin (SRMR or a DNSMOS stand-in as the target)."""
