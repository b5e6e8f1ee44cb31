"""Query-side views over device spans."""
