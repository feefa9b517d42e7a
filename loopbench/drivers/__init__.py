"""One module per way of driving a loop; ``harness.driver_class`` finds a
cell's by the name its workload file gives."""
