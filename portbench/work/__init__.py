"""Each configuration's work count (``work/<work>.py``), named by its configuration."""
