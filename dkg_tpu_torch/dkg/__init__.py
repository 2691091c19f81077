"""The batched ceremony engine, the committee wire protocol (phases 1-5, batched rounds 1-2 and the complaint court) and the error taxonomy."""
