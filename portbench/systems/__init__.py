"""The systems under test, one module a configuration's ``system``."""
