"""The benchmark's frozen arithmetic: what later changes to the program
cannot move."""
