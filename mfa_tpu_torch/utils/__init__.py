"""Device selection and test helpers."""
