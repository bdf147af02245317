"""Each configuration's comparison (``checks/<check>.py``), named by its configuration."""
