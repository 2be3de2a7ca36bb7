"""Port subpackage; see the modules."""
