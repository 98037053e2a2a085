// PIL's filled polygon (ImageDraw.polygon(xy, fill=v) on an 8-bit image),
// for the COCO 2014 instance masks of the data path of the port.
//
// What PIL does, and this file does the same way:
//   * vertices: the coordinates are doubles, each cast to int (truncated
//     towards zero, _imaging.c _draw_polygon);
//   * edges (Draw.c ImagingDrawPolygon): one per pair of consecutive
//     vertices, and a closing one unless the last vertex equals the first;
//     a horizontal edge that continues the horizontal edge before it in the
//     same x direction extends that edge instead;
//   * fill (Draw.c polygon_generic): horizontal edges are drawn as spans
//     of their own; every other edge gives each scanline y in [ymin, ymax]
//     the float crossing x = (y - y0) * dx + x0, counted twice at the
//     edge's lower end (ymax) unless that row is the polygon's last;
//     where a sloped edge starts (or ends) on this row at the rounded
//     crossing of the first earlier sloped edge that also starts (ends)
//     here, its crossing moves to one pixel past both edges' crossings of
//     the next row (the previous row at the ends) when it lies more than
//     one pixel beyond both ("connect discontiguous corners"); the
//     crossings are sorted and each pair fills [round-half-up(x0),
//     round-half-down(x1)], clipped to the image.  All of it in float, as
//     PIL's C computes it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
  int x0, y0, xmin, ymin, xmax, ymax;
  float dx;
};

Edge make_edge(int x0, int y0, int x1, int y1) {
  Edge e;
  e.xmin = std::min(x0, x1), e.xmax = std::max(x0, x1);
  e.ymin = std::min(y0, y1), e.ymax = std::max(y0, y1);
  e.dx = y0 == y1 ? 0.0f : ((float)(x1 - x0)) / (y1 - y0);
  e.x0 = x0, e.y0 = y0;
  return e;
}

int round_up(float f) {
  return (int)(f >= 0.0 ? floorf(f + 0.5f) : -floorf(fabsf(f) + 0.5f));
}

int round_down(float f) {
  return (int)(f >= 0.0 ? ceilf(f - 0.5f) : -ceilf(fabsf(f) - 0.5f));
}

void hline(uint8_t* m, int h, int w, int x0, int y, int x1, uint8_t ink) {
  if (y < 0 || y >= h) return;
  if (x0 < 0) x0 = 0;
  else if (x0 >= w) return;
  if (x1 < 0) return;
  if (x1 >= w) x1 = w - 1;
  if (x0 <= x1) memset(m + (int64_t)y * w + x0, ink, x1 - x0 + 1);
}

void fill_edges(uint8_t* m, int h, int w, std::vector<Edge>& e, uint8_t ink) {
  const int n = (int)e.size();
  if (n <= 0) return;
  std::vector<Edge*> table;
  int ymin = h - 1, ymax = 0;
  for (int i = 0; i < n; i++) {
    ymin = std::min(ymin, e[i].ymin);
    ymax = std::max(ymax, e[i].ymax);
    if (e[i].ymin == e[i].ymax) {
      hline(m, h, w, e[i].xmin, e[i].ymin, e[i].xmax, ink);
      continue;
    }
    table.push_back(&e[i]);
  }
  if (ymin < 0) ymin = 0;
  if (ymax > h) ymax = h;
  std::vector<float> xx(table.size() * 2 + 1);
  for (; ymin <= ymax; ymin++) {
    int j = 0;
    for (int i = 0; i < (int)table.size(); i++) {
      const Edge* cur = table[i];
      if (ymin < cur->ymin || ymin > cur->ymax) continue;
      xx[j++] = (ymin - cur->y0) * cur->dx + cur->x0;
      if (ymin == cur->ymax && ymin < ymax) {
        xx[j] = xx[j - 1];
        j++;
      } else if (cur->dx != 0) {
        for (int k = 0; k < i; k++) {
          const Edge* other = table[k];
          if (other->dx == 0) continue;
          // the two edges meet here: both start on this row, or both end on it
          if (!((ymin == cur->ymin && ymin == other->ymin) ||
                (ymin == cur->ymax && ymin == other->ymax)) ||
              roundf(xx[j - 1]) != roundf((ymin - other->y0) * other->dx + other->x0))
            continue;
          const int offset = ymin == cur->ymax ? -1 : 1;
          const float adj = (ymin + offset - cur->y0) * cur->dx + cur->x0;
          if (ymin + offset >= other->ymin && ymin + offset <= other->ymax) {
            const float adj_other = (ymin + offset - other->y0) * other->dx + other->x0;
            if (xx[j - 1] > adj + 1 && xx[j - 1] > adj_other + 1)
              xx[j - 1] = roundf(fmaxf(adj, adj_other)) + 1;
            else if (xx[j - 1] < adj - 1 && xx[j - 1] < adj_other - 1)
              xx[j - 1] = roundf(fminf(adj, adj_other)) - 1;
            break;
          }
        }
      }
    }
    std::sort(xx.begin(), xx.begin() + j);
    for (int i = 1; i < j; i += 2)
      hline(m, h, w, round_up(xx[i - 1]), ymin, round_down(xx[i]), ink);
  }
}

}  // namespace

extern "C" {

// mask: uint8 [h, w], drawn into in place.  coords: the polygons' x, y pairs
// one after the other; starts: npoly + 1 offsets into coords (in numbers, so
// polygon p is coords[starts[p] .. starts[p + 1])); values: one ink each.
// Polygons are filled in order.  Returns 0, or 1 + the first polygon with an
// odd count of numbers.
int64_t fill_polygons(uint8_t* mask, int h, int w, const double* coords, const int64_t* starts,
                      int64_t npoly, const uint8_t* values) {
  for (int64_t p = 0; p < npoly; p++) {
    const int64_t a = starts[p], len = starts[p + 1] - a;
    if (len % 2) return p + 1;
    const int count = (int)(len / 2);
    if (count <= 0) continue;
    std::vector<int> xy(2 * count);
    for (int i = 0; i < 2 * count; i++) xy[i] = (int)coords[a + i];
    std::vector<Edge> e;
    e.reserve(count);
    int i = 0;
    for (; i < count - 1; i++) {
      const int x0 = xy[2 * i], y0 = xy[2 * i + 1], x1 = xy[2 * i + 2], y1 = xy[2 * i + 3];
      if (y0 == y1 && i != 0 && y0 == xy[2 * i - 1]) {
        Edge& last = e.back();
        if (x1 > x0 && x0 > xy[2 * i - 2]) {
          last.xmax = x1;
          continue;
        } else if (x1 < x0 && x0 < xy[2 * i - 2]) {
          last.xmin = x1;
          continue;
        }
      }
      e.push_back(make_edge(x0, y0, x1, y1));
    }
    if (xy[2 * i] != xy[0] || xy[2 * i + 1] != xy[1])
      e.push_back(make_edge(xy[2 * i], xy[2 * i + 1], xy[0], xy[1]));
    fill_edges(mask, h, w, e, values[p]);
  }
  return 0;
}

}  // extern "C"
