"""Traffic mixes (``<mix>.json``) and the generators they name."""
