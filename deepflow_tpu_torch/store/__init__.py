"""In-memory columnar store for the profile tables: dictionary-encoded
string columns, enum columns and fixed-width integer columns."""
