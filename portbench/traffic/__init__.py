"""One module per traffic kind, found by the kind's name."""
