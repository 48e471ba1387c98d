"""The harness: finds a cell by name, drives the program, reduces what it
records to metrics and checks what it served."""
