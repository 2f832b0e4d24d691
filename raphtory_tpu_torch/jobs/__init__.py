"""Job orchestration over the columnar engine."""
