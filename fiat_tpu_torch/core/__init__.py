"""Host-side construction: cells, expansion sets, dual sets, elements."""
