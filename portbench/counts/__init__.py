"""The yardstick's arithmetic: data-sheet peaks, operations and bytes of
each kernel and of a whole call, all functions of shapes."""
