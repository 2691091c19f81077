"""The batched ceremony engine and its error taxonomy."""
